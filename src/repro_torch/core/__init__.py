"""Algorithm 1's core modules, ported from ``repro.core``."""
