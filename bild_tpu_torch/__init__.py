"""
bild_tpu_torch — Bayesian Inference of Looping Dynamics in PyTorch, with
hand-written CUDA kernels for NVIDIA Hopper (H100).

A port of `bild_tpu` (JAX/Pallas), which stays the reference. Public
surface as there: ``sample``, ``SamplingResults``, ``Loopingprofile``,
``Trajectory`` and the submodules, with ``parallel`` (the dataset runners:
`parallel.sample_batch`, `parallel.sample_dataset`, lockstep or adaptive,
split over the ranks of a `torch.distributed` process group with
``mesh=``, and `parallel.sample_dataset_sharded` for shards held by each
rank), ``postproc``, ``stats``, ``io`` (CSV loading), ``fit`` (Rouse and
GGM calibration) and ``util`` (the reference's name for ``profiles``);
``experimental`` (the temporal-parallel likelihood);
``utils`` (result checkpoints) and the CLI ``python -m bild_tpu_torch``
are imported on use. Every constructor takes an explicit ``device=`` and
``dtype=``; every random draw comes from an explicit `torch.Generator`.
The CUDA kernels (``csrc/``) and the native CSV parser build on first use;
importing the package needs neither a GPU nor ``nvcc``.
"""

from .profiles import Loopingprofile, state_probabilities  # noqa: F401
from .trajectory import Trajectory, make_trajectory  # noqa: F401
from . import config  # noqa: F401
from . import profiles  # noqa: F401
from . import profiles as util  # noqa: F401  (the reference's name)
from . import physics  # noqa: F401
from . import ops  # noqa: F401
from . import models  # noqa: F401
from . import amis  # noqa: F401
from . import io  # noqa: F401
from . import parallel  # noqa: F401
from . import postproc  # noqa: F401
from . import stats  # noqa: F401
from . import fit  # noqa: F401
from . import experimental  # noqa: F401
from .infer import sample, SamplingResults  # noqa: F401
from .infer.choice import ChoiceSampler  # noqa: F401

__version__ = "0.1.0"
