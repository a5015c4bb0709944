"""Model zoo of the port: ``vision`` (ResNets) and ``language`` (BERT,
Llama)."""
from . import vision  # noqa: F401
