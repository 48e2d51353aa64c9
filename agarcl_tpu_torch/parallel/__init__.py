from agarcl_tpu_torch.parallel.mesh import (EnvMesh, ShardedVecEnv,
                                            make_env_mesh)

__all__ = ["EnvMesh", "ShardedVecEnv", "make_env_mesh"]
