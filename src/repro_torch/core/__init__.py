"""Model and embedding-tier modules of the port."""
