"""Tracing of the port: the frame timer, the profiler trace and logging setup."""
