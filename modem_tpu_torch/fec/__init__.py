"""Polar and BCH coding: numpy construction, PyTorch transforms."""
