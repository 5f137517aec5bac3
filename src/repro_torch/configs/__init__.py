"""Configurations of the port (counterpart of ``repro/configs``)."""
