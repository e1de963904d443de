"""Fault tolerance."""
from . import manager
