from .criteria import check_refinement, RefinementConfig  # noqa: F401
from .prolong_restrict import prolongate_minmod, restrict_average  # noqa: F401
