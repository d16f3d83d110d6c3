from . import counting, cuda_hist, sort, xla_sort  # noqa: F401
