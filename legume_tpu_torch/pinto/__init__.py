"""`pinto`: spatial-transcriptomics link communities (the port of the JAX
package's `pinto/`)."""
