from ust_run_tpu_torch.parallel.mesh import (  # noqa: F401
    DataMesh, GroupSizes, Mesh, bind_mesh, check_num_devices,
    init_distributed, shard_slice, sync_batchnorm)
