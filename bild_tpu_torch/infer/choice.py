"""
Information-gain driven sample selection across switch counts k.

Reference parity: the ``ChoiceSampler`` of ``bild/choicesampler.py`` (same
decision semantics, re-derived and fully vectorized). Given the evidence
curve — point estimates ``logev``, squared standard errors ``var_logev``,
and AMIS step counts ``n_steps`` per k — plus the evidence margin, this
class Monte-Carlo-estimates the *choice distribution* p(k): the probability
that k would be selected as "best" under the margin rule if the true
evidence curve were drawn from the current error bars. From that it scores

- `KLD_moreSamples`: the expected KL information gain of spending one more
  AMIS step at each k, and
- `KLD_omitK`: how much information a region of k contributes at all (the
  lookahead importance used to decide whether to open a new k).

All variants are evaluated on one cached set of evidence-curve draws
(common random numbers), which is what makes the KL *differences*
low-variance. Everything here is host-side control logic on tiny
``(samplesize, k)`` arrays — dispatching it to the device would cost more
in latency than the whole computation. A copy of `bild_tpu.infer.choice`.
"""
from __future__ import annotations

import numpy as np

__all__ = ["ChoiceSampler"]


class ChoiceSampler:
    """
    Monte-Carlo scorer for "where should the next AMIS step go?".

    Parameters
    ----------
    logev : (k,) array
        evidence point estimates per switch count
    var_logev : (k,) array
        squared standard errors of `logev`
    n_steps : (k,) array
        AMIS steps behind each estimate; ``inf`` marks an exhausted sampler
        (its evidence can no longer move, so its expected gain is zero)
    margin : float
        the evidence margin dE: among k whose (drawn) evidence lies within
        `margin` of the maximum, the smallest k wins
    samplesize : int
        number of Monte-Carlo draws of the evidence curve
    rng : numpy Generator, optional
        source of the curve draws; pass one derived from the inference key
        for reproducible runs (``sample`` does). Defaults to a fresh
        OS-seeded generator.

    Attributes
    ----------
    counts0 : (k,) int array
        histogram of the winning k over the cached draws; ``counts0 /
        samplesize`` is the choice distribution p(k).
    step_rms : (k,) array
        root-mean-square evidence shift expected from one more AMIS step at
        each k (``sqrt(var_logev / (n_steps + 1))``).
    """

    def __init__(self, logev, var_logev, n_steps, margin,
                 samplesize=10000, rng=None, noise=None):
        self.logev = np.asarray(logev, dtype=float)
        self.var_logev = np.asarray(var_logev, dtype=float)
        self.margin = float(margin)
        self.samplesize = int(samplesize)
        self.n_k = len(self.logev)

        n_steps = np.asarray(n_steps, dtype=float)
        self.step_rms = np.sqrt(self.var_logev / (n_steps + 1.0))

        if rng is None:
            rng = np.random.default_rng()
        self._rng = rng
        self.init_sample(noise=noise)

    def init_sample(self, noise=None):
        """
        (Re-)draw the cached evidence-curve sample underlying every score.

        One cached set of draws underlies *every* variant evaluated below
        (common random numbers); calling this again re-randomizes an
        existing instance, like the reference's
        ``ChoiceSampler.init_sample`` (``bild/choicesampler.py:99-110``).
        ``noise`` injects the ``(samplesize, k)`` standard-normal draws
        directly (decision-parity testing).
        """
        if noise is None:
            noise = self._rng.standard_normal((self.samplesize, self.n_k))
        else:
            noise = np.asarray(noise, dtype=float)
        self.samplesize = noise.shape[0]
        self._curves = self.logev + np.sqrt(self.var_logev) * noise
        self.counts0 = self._tally(self._pick(self._curves))

    # -- core selection rule ------------------------------------------------

    def _pick(self, curves):
        """Winning k per draw: smallest k whose evidence lies within
        `margin` of that draw's maximum. ``curves``: (..., samplesize, k)."""
        floor = np.max(curves, axis=-1, keepdims=True) - self.margin
        # argmax over booleans = first index satisfying the margin rule
        return np.argmax(curves >= floor, axis=-1)

    def _tally(self, picks):
        """Histogram the winning ks: (..., samplesize) -> (..., k)."""
        return np.sum(picks[..., None] == np.arange(self.n_k), axis=-2)

    def evaluate(self, k_change=None, n_step=0.0, omit_k=None):
        """
        Winning k per draw, optionally after shifting one k's evidence by
        ``n_step`` rms steps, or pretending some k were never explored.
        """
        curves = self._curves
        if k_change is not None or omit_k is not None:
            curves = curves.copy()
            if k_change is not None:
                curves[:, k_change] += n_step * self.step_rms[k_change]
            if omit_k is not None:
                # excluded from the max and never within the margin
                curves[:, omit_k] = -np.inf
        return self._pick(curves)

    # -- information-gain scores ---------------------------------------------

    def Dn(self):
        """
        Expected change in the choice-distribution histogram.

        ``Dn()[k1, k2]`` is the expected change in the histogram count of
        k=k2 upon adding one AMIS step at k=k1, probed by a central
        difference: shift each k's column of the cached draws by ±half an
        rms step and compare the two histograms (reference
        ``bild/choicesampler.py:153-166``). Rows of exhausted k are zero.
        """
        shift = np.diag(0.5 * self.step_rms)          # (k, k), zero rows for exhausted k
        up = self._tally(self._pick(self._curves[None] + shift[:, None, :]))
        down = self._tally(self._pick(self._curves[None] - shift[:, None, :]))
        return (up - down).astype(float)              # (k_probed, k)

    def KLD_moreSamples(self):
        """
        Expected KL information gain of one additional AMIS step at each k.

        The evidence shift from one more step is symmetric around zero, so
        the expected *change* in the choice distribution vanishes — but the
        expected KL divergence is quadratic in the change and does not:
        KL ≈ Σ Dn² / (2·samplesize·(counts+1)) per probed k.
        """
        swing = self.Dn()                             # (k_probed, k)
        return np.sum(swing**2 / (self.counts0 + 1.0), axis=-1) \
            / (2.0 * self.samplesize)

    def KLD_omitK(self, omit_k):
        """
        Information contributed by the k in ``omit_k``: the KL divergence
        between the full choice distribution and the one obtained as if
        those k had never been explored. Used as the lookahead importance.
        """
        reduced = self._tally(self.evaluate(omit_k=omit_k)).astype(float)
        reduced *= self.samplesize / np.sum(reduced)
        gap = self.counts0 - reduced
        # Changes *at* the omitted positions would contribute infinite KL
        # (reduced counts are zero there by construction); they are not what
        # this score is about.
        gap[omit_k] = 0.0
        return np.sum(gap**2 / (reduced + 1.0)) / (2.0 * self.samplesize)
