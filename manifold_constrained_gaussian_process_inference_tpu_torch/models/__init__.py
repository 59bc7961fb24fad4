from .base import OdeSystem, get_system, register, registered_systems  # noqa: F401
from .systems import FN_SYSTEM, fn_f, fn_f_dtheta, fn_f_dx  # noqa: F401
