"""Input generators, one module per problem family, found by the name a
configuration gives under ``generator``."""
