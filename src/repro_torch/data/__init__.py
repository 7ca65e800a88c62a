"""Synthetic ANN datasets (numpy generators shared bit for bit with the
reference) and exact ground truth in torch."""
