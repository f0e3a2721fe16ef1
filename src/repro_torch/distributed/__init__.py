"""Pipeline execution of the port: the serving tick's ring of S stages on
one device (`pipeline`) and re-staging a model between pipeline factorings
(`elastic`)."""
