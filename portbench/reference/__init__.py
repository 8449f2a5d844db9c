"""The plain reference that decides whether a cell's run is correct.

Plain PyTorch and NumPy, written from the published architectures and the
pipeline's documented numerics, with nothing of ``playaid_core_torch``
imported: the YUV420 unpack, the host window cut and the bilinear window
resize (``ops``), ResNet-18 and ResNet-50, the dense and transformer heads
and the middle-out window gather (``models``), the Viterbi decode
(``ops``), and the weights read from the committed ``.npz`` or drawn from
the seed (``weights``).  Float32 runs with TF32 off unless a caller asks
for the TF32 control (:func:`models.precision`).
"""
