from .interp import VM, Execution, HostHandler, VMProgram, VMValue

__all__ = ["VM", "Execution", "HostHandler", "VMProgram", "VMValue"]
