from .evaluation import assignment_accuracy, mixture_nlpd, mixture_rmse
from .kmeans import kmeans_centers
from .metrics import MetricsLogger
from .shapes import ShapeChecker, ShapeError, check_shape

__all__ = ["MetricsLogger", "ShapeChecker", "ShapeError", "assignment_accuracy",
           "check_shape", "kmeans_centers", "mixture_nlpd", "mixture_rmse"]
