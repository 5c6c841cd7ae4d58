"""The plain float32 reference that decides ``correct``.

Frozen copies of the port's plain PyTorch code (no kernel, no batching, no
cache), taken from ``transtacos_retunegan_tpu_torch`` as it stood when the
benchmark was defined, so that no later change to the port moves the
yardstick: ``config.py``; ``text/{frontend,g2p,symbols,phonology}.py``;
``audio/{dsp,mel}.py``; ``models/{layers,encoder,decoder,acoustic,
generators,vocoder_layers,discriminators,vocoder_losses,precision}.py``;
``train/optim.py`` as ``optim.py``.  Changed in the copies: the acoustic
model builds the stock decoder cell only (``decoder_fast.py`` is not
copied), and ``parallel.py`` holds the one-process form of each collective
the models call.  ``serve.py`` and ``gan.py`` are the reference's own: a
served request and the GAN step, one at a time.  Nothing here imports
``jax`` or either package of this repository.
"""
