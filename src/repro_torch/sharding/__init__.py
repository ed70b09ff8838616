from repro_torch.sharding.rules import (NO_SHARDING, AbstractMesh, Sharding,
                                        ShardingPolicy, make_policy,
                                        param_sharding)

__all__ = ["ShardingPolicy", "make_policy", "param_sharding", "NO_SHARDING",
           "AbstractMesh", "Sharding"]
