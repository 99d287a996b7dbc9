from marius_tpu_torch.nn.layers.layers import (  # noqa: F401
    LayerConfig,
    apply_activation,
    embedding_layer,
    feature_layer,
    gcn_layer,
    graph_sage_layer,
    init_layer_params,
    post_hook,
    reduction_layer,
)
