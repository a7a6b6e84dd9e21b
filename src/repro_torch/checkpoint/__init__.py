"""Checkpoints: ``store`` (async save, atomic publish, retention, restore
onto the devices and dtypes of a template tree).  Importing the package
imports it not."""
