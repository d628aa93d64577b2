"""`chickpea`: peak-to-gene cis-regulatory linkage (the port of the JAX
package's `chickpea/`)."""
