from .parameter_input import ParameterInput  # noqa: F401
