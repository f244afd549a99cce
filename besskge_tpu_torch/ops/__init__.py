"""Distance ops of the port and their hand-written CUDA kernels."""

from besskge_tpu_torch.ops.distance import p_distance_matrix  # noqa: F401
