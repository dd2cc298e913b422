"""Runtime, options and logging, checkpoint interop."""
