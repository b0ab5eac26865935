"""Rome16K component lists (reference: runners/rome16k/Rome16K.py)."""

import os


class Rome16K:
    def __init__(self, list_file, component_folder):
        self.imname_list = []
        self.component_map = {}
        self.components = {}
        self.load_image_list(list_file)
        self.load_components(component_folder)

    def load_image_list(self, list_file):
        with open(list_file) as f:
            self.imname_list = [ln.split()[0] for ln in f if ln.strip()]

    def load_components(self, component_folder):
        for fname in sorted(os.listdir(component_folder)):
            if not fname.endswith(".txt"):
                continue
            cid = int(os.path.splitext(fname)[0].split(".")[-1]) \
                if fname.split(".")[-2].isdigit() else len(self.components)
            with open(os.path.join(component_folder, fname)) as f:
                ids = [int(tok) for tok in f.read().split()]
            self.components[cid] = ids
            for i in ids:
                self.component_map[i] = cid

    def get_imname(self, img_id):
        return self.imname_list[img_id]

    def count_components(self):
        return len(self.components)

    def get_images_in_component(self, c_id):
        return self.components[c_id]
