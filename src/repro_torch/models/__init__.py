"""Model zoo of the port (see repro_torch.configs): the dense family.

Port of src/repro/models/__init__.py."""
from repro_torch.models.registry import Model, build_model

__all__ = ["Model", "build_model"]
