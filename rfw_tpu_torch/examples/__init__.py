"""The examples of ``examples/`` ported to rfw_tpu_torch, one module each,
run as ``python -m rfw_tpu_torch.examples.<name>``: ``cornell``,
``textured_env``, ``instances``, ``animation`` and ``viewer``.

Each keeps its rfw_tpu counterpart's scene, camera, arguments and
defaults, renders on the CUDA card unless ``--device cpu`` is passed
(without a card the default raises ``RuntimeError``), and exposes
``main(argv=None) -> int``. Where the counterpart loads an asset that is
not in the repository, the example takes its path as an argument and
otherwise builds a stand-in from ``utils/synthetic.py``.
"""
