"""Static checks of execution-plan manifests (the plan lints of the
reference's ``analysis`` package; its HLO lints and retrace sentinel have
no counterpart in the port).

``lint_plan(plan)`` returns :class:`Finding` lists; ``format_findings``
prints them, ``waive`` drops rule ids, and ``gate`` gives the exit code
(1 if an error finding survives). ``launch.serve --analyze`` runs them.
"""
from repro_torch.analysis.findings import (ERROR, INFO, WARNING, Finding, errors,
                                           findings_to_json, format_findings, gate, waive)
from repro_torch.analysis.plan_lints import DEFAULT_MESH_AXES, lint_plan, lint_plan_file

__all__ = ["ERROR", "WARNING", "INFO", "Finding", "errors", "findings_to_json",
           "format_findings", "gate", "waive", "lint_plan", "lint_plan_file",
           "DEFAULT_MESH_AXES"]
