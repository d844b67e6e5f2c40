from .base import Model, ModelSpec
from .classifiers import (
    CentroidParams,
    GNBParams,
    LinearParams,
    build_model,
    centroid_predict_err,
    make_centroid,
    make_gnb,
    make_linear,
    make_majority,
)

__all__ = [
    "CentroidParams",
    "GNBParams",
    "LinearParams",
    "Model",
    "ModelSpec",
    "build_model",
    "centroid_predict_err",
    "make_centroid",
    "make_gnb",
    "make_linear",
    "make_majority",
]
