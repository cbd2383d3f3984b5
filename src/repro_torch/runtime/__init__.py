from .health import StragglerPolicy

__all__ = ["StragglerPolicy"]
