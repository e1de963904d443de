"""Optimizers."""
from . import adamw
