"""Scaling: the device mesh, tensor parallelism of the ConvLSTM gates,
per-rank input ownership, the spatial row split (``spatial``) and the
multi-process check (the JAX package's ``vad_tpu/parallel/``).  Importing
it touches no device and starts no process group."""

from vad_tpu_torch.parallel.sharding import (  # noqa: F401
    DATA_AXIS,
    MODEL_AXIS,
    Mesh,
    convlstm_param_shardings,
    data_parallel,
    get_mesh,
    init_distributed,
    pad_batch_for_devices,
    padded_batch_size,
    spatial_frame_sharding,
    spatial_state_sharding,
)
