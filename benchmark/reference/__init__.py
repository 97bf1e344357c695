"""Plain PyTorch references that decide `correct`. They import neither
the port nor the JAX package, and take nothing the program made."""
