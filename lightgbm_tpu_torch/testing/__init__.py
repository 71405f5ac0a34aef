"""Fault injection for the port's serving fleet (``faults``)."""
