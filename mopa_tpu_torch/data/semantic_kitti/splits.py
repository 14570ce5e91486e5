"""SemanticKITTI sequence splits (a copy of
``mopa_tpu/data/semantic_kitti/splits.py``: the official semantic-kitti.yaml
partition)."""

train = ['00', '01', '02', '03', '04', '05', '06', '09', '10']
val = ['07']
test = ['08']
hidden_test = ['{:02d}'.format(i) for i in range(11, 22)]
