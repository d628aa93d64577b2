"""`fagioli`: GWAS and single-cell eQTL fine-mapping (the port of the JAX
package's `fagioli/`)."""
