"""Configs: the assigned architectures, resolved by ``registry.get_arch``."""
