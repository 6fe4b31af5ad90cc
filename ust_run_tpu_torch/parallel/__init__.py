from ust_run_tpu_torch.parallel.mesh import (  # noqa: F401
    DataMesh, GroupSizes, check_num_devices, init_distributed, shard_slice,
    sync_batchnorm)
