"""Host-side data plumbing of the port."""
