"""Per-layer backend registry and execution-plan compiler.

Importing the package registers the built-in backends."""
from repro_torch.engine import backends  # noqa: F401  (registers)
from repro_torch.engine.plan import ExecutionPlan, LayerAssignment, compile_plan
from repro_torch.engine.registry import (BackendSpec, LeafContext, PackContext,
                                         register_backend)
