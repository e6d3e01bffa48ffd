"""The LM substrate's models (the port of ``repro.models``): decoder LM,
encoder-decoder and VLM over GQA / MLA attention, MoE and Mamba-2 layers.
``registry.get_model(cfg)`` is the entry point."""
