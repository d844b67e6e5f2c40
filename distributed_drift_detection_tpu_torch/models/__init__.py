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
from .mlp import MLPLayer, make_mlp, mlp_fit, mlp_predict_err

__all__ = [
    "CentroidParams",
    "GNBParams",
    "LinearParams",
    "MLPLayer",
    "Model",
    "ModelSpec",
    "build_model",
    "centroid_predict_err",
    "make_centroid",
    "make_gnb",
    "make_linear",
    "make_majority",
    "make_mlp",
    "mlp_fit",
    "mlp_predict_err",
]
