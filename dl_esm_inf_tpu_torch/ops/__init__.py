"""Per-device compute: stencil primitives and the fused sweep kernels."""
