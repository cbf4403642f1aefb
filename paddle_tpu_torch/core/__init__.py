"""Device, generator and flag plumbing shared by the port."""
