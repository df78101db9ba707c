from strutopy_tpu_torch.parallel.mesh import default_mesh, make_mesh
from strutopy_tpu_torch.parallel.sharding import make_sharded_em_step

__all__ = ["make_mesh", "default_mesh", "make_sharded_em_step"]
