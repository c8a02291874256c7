from .ale import AleMap, parse_kind

__all__ = ["AleMap", "parse_kind"]
