from .rouse import RouseModel, two_locus_msd  # noqa: F401
