"""Stage-1 basic ball training recipe.

Parity: reference ``configs/ball_action/sampling_weights_001.py`` —
ImageNet-pretrained encoder, focal γ=1.2 α=-1, AdamW batch-scaled 3e-4,
6 warmup + 30 cosine epochs, 6000-sample epochs, EMA 0.999, 50/50
action-window/background sampling. All values are those of the recipe function
defaults.
"""

from ball_action_spotting_torch.domains import ball
from ball_action_spotting_torch.utils.recipe import spotting_recipe

config = spotting_recipe(num_classes=ball.num_classes)
