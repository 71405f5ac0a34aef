"""Device ops: the plain gather walk and the forest-walk kernel."""
