"""One driver per kind of traffic, named by a mix's ``driver`` field."""
