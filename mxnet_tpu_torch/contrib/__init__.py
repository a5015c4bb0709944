"""Contrib packages of the port."""
