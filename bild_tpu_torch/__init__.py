"""
bild_tpu_torch — Bayesian Inference of Looping Dynamics in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (H100).

A port of `bild_tpu` (JAX/Pallas), which stays the reference. Public
surface as there: ``sample``, ``SamplingResults``, ``Loopingprofile``,
``Trajectory`` and the submodules, with ``parallel`` (the lockstep dataset
runner: `parallel.sample_batch`, `parallel.sample_dataset`), ``postproc``
and ``stats``. Every constructor takes an explicit
``device=`` and ``dtype=``; every random draw comes from an explicit
`torch.Generator`. The CUDA kernels (``csrc/``) build on first use on a
CUDA tensor; importing the package needs neither a GPU nor ``nvcc``.
"""

from .profiles import Loopingprofile, state_probabilities  # noqa: F401
from .trajectory import Trajectory, make_trajectory  # noqa: F401
from . import config  # noqa: F401
from . import profiles  # noqa: F401
from . import physics  # noqa: F401
from . import ops  # noqa: F401
from . import models  # noqa: F401
from . import amis  # noqa: F401
from . import parallel  # noqa: F401
from . import postproc  # noqa: F401
from . import stats  # noqa: F401
from .infer import sample, SamplingResults  # noqa: F401
from .infer.choice import ChoiceSampler  # noqa: F401

__version__ = "0.1.0"
