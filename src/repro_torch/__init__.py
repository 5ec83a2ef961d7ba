"""PyTorch/CUDA port of the GR-CIM reproduction (``repro``, the JAX
package, is the reference). It imports torch and numpy, never JAX or
anything of ``repro``. Entry points run on the CUDA card unless the caller
passes ``device="cpu"``, where every GR-MAC call takes its plain version.
"""
