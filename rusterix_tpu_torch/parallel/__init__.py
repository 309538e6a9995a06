"""Row-sharded frames over a mesh of torch devices (parallel/mesh.py)."""

from .mesh import (
    card_mesh,
    check_mesh,
    make_mesh,
    render_frame_sharded,
    render_sharded_jit,
    sharded_inputs,
)

__all__ = ["card_mesh", "check_mesh", "make_mesh", "render_frame_sharded", "render_sharded_jit",
           "sharded_inputs"]
