from . import image, logger, serial, tracing
from .timer import Averager, Timer

__all__ = ["image", "logger", "serial", "tracing", "Averager", "Timer"]
