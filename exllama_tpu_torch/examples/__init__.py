"""The examples of the repo's ``examples/``, on the port: each runs as
``python -m exllama_tpu_torch.examples.<name>`` with a checkpoint (``-d``)
or a synthetic model (``--synthetic tiny``), on the card unless ``--cpu``
is given; ``--max_new`` shortens each one's generation."""
