from sofima_tpu_torch.parallel.mesh_sharding import (
    make_mesh,
    relax_mesh_sharded,
    sharded_flow_step,
)
