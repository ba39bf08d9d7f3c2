"""Native host code: the JAX-free loader of the C++ oracle."""
