from .base import Model, ModelSpec
from .classifiers import (
    CentroidParams,
    build_model,
    centroid_predict_err,
    make_centroid,
    make_majority,
)

__all__ = [
    "CentroidParams",
    "Model",
    "ModelSpec",
    "build_model",
    "centroid_predict_err",
    "make_centroid",
    "make_majority",
]
