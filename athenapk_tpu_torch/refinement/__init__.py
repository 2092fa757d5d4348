from .prolong_restrict import prolongate_minmod, restrict_average  # noqa: F401
