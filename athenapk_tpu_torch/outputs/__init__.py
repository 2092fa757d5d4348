from .history import HistoryOutput  # noqa: F401
