"""Tooling of the port: its API reference generator and convention lint."""
