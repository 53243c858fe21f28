"""Data parallelism across processes (the port's counterpart of the JAX
package's ``parallel/``)."""
