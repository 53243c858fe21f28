"""Scene-graph vocabulary: label groups and relation phrase banks, the
port's own copy of ``sceneverse_tpu/preprocess/ssg/dictionary.py``
(public template data, as consumed by the reference at
preprocess/ssg/ssg_data/dictionary.py)."""

above_express = ['above', 'higher than']

added_hanging = {'curtain rod': ['curtain'], 'shower curtain rod': ['shower curtain']}

always_supported = ['wall', 'wall hanging', 'bath walls', 'closet wall', 'closet walls', 'closet wall', 'closet walls', 'door wall', 'pantry wall', 'pantry walls', 'shower wall', 'shower walls', 'door', 'sliding door', 'sliding wood door', 'bathroom stall door', 'doors', 'door frame']

below_express = ['below', 'lower than']

close_express = ['close to', 'adjacent to', 'beside', 'next to']

component = {'closet': ['closet ceiling', 'closet door', 'closet doorframe', 'closet doors', 'closet rod', 'closet shelf'], 'cabinet': ['cabinet door', 'cabinet doors']}

embed_express = ['']

hanging = ['window', 'curtain', 'curtains', 'shower curtain', 'curtain rod', 'shower curtain rod']

hanging_express = ['hanging on', 'hung on']

inside_express = ['']

must_support_scannetpp = ['chair', 'sofa', 'table', 'bookshelf', 'standing lamp', 'shoe', 'backpack', 'bag', 'mat', 'barbell', 'dumbbell', 'trash bin', 'basket', 'tv stand', 'tablet', 'mop', 'vacum cleaner']

opp_embed_express = ['embedded into', 'placed within the area of']

opp_inside_express = ['inside', 'placed within the area of']

opp_support_express = ['resting on', 'placed on', 'on', 'supported by', 'on the top of']

support_express = ['support']

under_express = ['above']

