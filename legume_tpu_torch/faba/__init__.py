"""faba's gene models (the port of the JAX package's `faba/`, so far its GFF reader)."""
