"""The plain reference: the same mathematics as the solver under test,
written again in plain PyTorch from its description. Imports nothing of the
port, of JAX or of the JAX package."""
