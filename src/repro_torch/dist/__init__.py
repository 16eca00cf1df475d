"""Distribution layer: logical-axis sharding over a torch DeviceMesh."""
from repro_torch.dist.api import (DEFAULT_RULES, DistContext, constraint,
                                  current, gather_fsdp, param_sharding,
                                  set_context, use_mesh)

__all__ = [
    "DEFAULT_RULES", "DistContext", "constraint", "current", "gather_fsdp",
    "param_sharding", "set_context", "use_mesh",
]
