"""Inference modules: layers, Xception-lite, Light-Head R-CNN."""
