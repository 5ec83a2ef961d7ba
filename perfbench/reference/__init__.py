"""The plain reference: frozen float32 PyTorch copies of the GR-MAC chain
(``grmac``), the dense transformer and Mamba2 SSD models (``dense_lm``,
``mamba2_lm``), AdamW (``optim``) and the serving policy that batches a
closed loop's requests into dispatches (``replay``). It imports nothing of
the port and reads none of its state: the benchmark hands it the raw
weights and inputs it made, and the port's outputs only to judge them."""
