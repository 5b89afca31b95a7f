from . import collectives, mining

__all__ = ["collectives", "mining"]
