"""Utilities of the port: the TensorBoard event writer."""

from .tb_writer import EventWriter, read_events

__all__ = ["EventWriter", "read_events"]
