from dealii_slod_tpu.ops import element, assembly, solvers  # noqa: F401
