# Port of src/repro/launch/: the multi-tenant SpMM serving endpoint, its
# continuous-batching scheduler and the LM generate driver
# (launch/serve.py), the training driver (launch/train.py) and its
# meshes (launch/mesh.py).
