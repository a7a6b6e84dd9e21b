"""The model stack's serving path in torch: ``config``, ``layers``,
``attention`` (self- and cross-attention), ``moe`` (capacity-routed
experts), ``ssm`` (Mamba2 SSD), ``rglru`` (Griffin's recurrent block) and
``model`` (every family).  Importing the package imports none of them."""
