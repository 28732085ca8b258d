"""The benchmark's plain reference: the guided VAE + NMF enhancement
algorithm written out again in plain PyTorch, for deciding `correct`.

It imports nothing of the program under test (the `_torch` port) and
nothing of JAX: it loads the shipped `.npz` weights itself, computes the
STFT and ISTFT as products with DFT matrices, and draws the chains'
random streams from the seed the way the algorithm defines them. Every
function takes a precision: "f64" is the reference, "tf32" the control
(the products' operands rounded to TF32, sums in float32).
"""
