"""Inference engine."""
