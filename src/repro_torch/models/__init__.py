"""The model stack's serving path in torch: ``config``, ``layers``,
``attention`` (dense family), ``ssm`` (Mamba2 SSD) and ``model``.
Importing the package imports none of them."""
