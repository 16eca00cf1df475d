"""Entry points of the port: ``serve`` (batched decode serving), ``train``
(the training launcher) and ``mesh`` (DeviceMesh construction)."""
from repro_torch.launch.mesh import (make_cpu_mesh, make_mesh,
                                     make_production_mesh)

__all__ = ["make_cpu_mesh", "make_mesh", "make_production_mesh"]
