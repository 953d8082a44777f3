"""Utilities of the port: the TensorBoard event writer, the profiling
helpers and the reference's small helpers."""

from .misc import add_three_dim_dict, add_two_dim_dict, corrupt_cameras, vis_density
from .profiling import device_memory_stats, phase, trace
from .tb_writer import EventWriter, read_events

__all__ = ["EventWriter", "add_three_dim_dict", "add_two_dim_dict", "corrupt_cameras",
           "device_memory_stats", "phase", "read_events", "trace", "vis_density"]
