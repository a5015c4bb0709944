"""Model zoo of the port: ``vision`` (ResNets) and ``language`` (Llama)."""
from . import vision  # noqa: F401
