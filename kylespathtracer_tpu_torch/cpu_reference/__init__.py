"""NumPy re-executions of the reference's GLSL math that the port's own
bench needs at run time (`glslref`). The tests' full oracle stays the JAX
package's `cpu_reference/`."""
