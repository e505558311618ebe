"""Launch layer of the port's training path: the end-to-end driver
(`train`) and the elastic control plane (`elastic`)."""
