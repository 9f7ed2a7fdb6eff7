from .shapes import ShapeChecker, ShapeError, check_shape

__all__ = ["ShapeChecker", "ShapeError", "check_shape"]
