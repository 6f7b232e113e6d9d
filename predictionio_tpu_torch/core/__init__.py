"""Deploy workflow of the port."""
