"""faba (the port of the JAX package's `faba/`, so far): the BAM reader
and writer, gene counting with splice classes, cell calling, the
dyn-assoc contrasts and GAM trends, and a simulated 10x-style BAM."""
