"""Detector statistics (DDM) and their kernels."""
