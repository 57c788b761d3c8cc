def default_trace_backend() -> str:
    """The trace backend for the platform JAX runs on: the fused Pallas
    range sweep (ugrt.trace.pallas_tracer, compiled through Triton) on a
    GPU, the XLA work-item pipeline on the CPU.  The XLA path is also the
    reference the kernel is tested against everywhere."""
    import jax

    platform = jax.default_backend()
    if platform == "gpu":
        return "pallas"
    if platform == "cpu":
        return "xla"
    raise RuntimeError(f"no trace backend for platform {platform!r}")

