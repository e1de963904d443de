"""Checkpointing."""
from . import store
