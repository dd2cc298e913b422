"""Inference trainer and grouped evaluation."""
