"""The client layer of the port: only `command.py` so far (plain Python,
imported by the server's region loop). The rest of the JAX package's
`client/` (the game client, its widgets and 2D drawing) builds on the
renderer's engine loop and has not been ported yet."""

from .command import Command, CommandKind

__all__ = ["Command", "CommandKind"]
