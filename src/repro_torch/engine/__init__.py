"""Per-layer backend registry, execution-plan compiler and its manifests.

Importing the package registers the built-in backends."""
from repro_torch.engine import backends  # noqa: F401  (registers)
from repro_torch.engine.plan import (PLAN_VERSION, ExecutionPlan, LayerAssignment,
                                     compile_plan, format_plan_table, plan_report)
from repro_torch.engine.registry import (BackendSpec, LeafContext, PackContext,
                                         backend_names, get_backend, register_backend,
                                         unregister_backend)
