"""Meshes of the serving and training layouts (the reference's
``launch/mesh.py``), built by functions, never as module constants, so
importing this module touches no device.

A port mesh is ``distributed.sharding.Mesh``: its positions go round-robin
over the visible cards (position p on ``cuda:(p mod n_cards)``), so on a
one-card machine every position of a mesh shares ``cuda:0``;
``device="cpu"`` puts them all on the CPU.
"""
from __future__ import annotations

from repro_torch.distributed.sharding import Mesh


def make_production_mesh(*, multi_pod: bool = False, device="cuda") -> Mesh:
    """16x16 ("data", "model"), or 2x16x16 ("pod", "data", "model")."""
    shape = (2, 16, 16) if multi_pod else (16, 16)
    axes = ("pod", "data", "model") if multi_pod else ("data", "model")
    return Mesh(shape, axes, device=device)


def make_debug_mesh(n_data: int = 2, n_model: int = 4, *, device="cuda") -> Mesh:
    """A small ("data", "model") mesh for tests and dry runs."""
    return Mesh((n_data, n_model), ("data", "model"), device=device)


def chips(mesh) -> int:
    """Positions of the mesh (the reference's chips)."""
    return mesh.devices.size
