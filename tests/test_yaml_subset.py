"""The in-repo YAML-subset reader (`hank_tpu.model.yaml_subset`).

It must read every shipped model spec exactly as `yaml.safe_load` does,
agree with it on each supported construct, and refuse everything outside
the subset with a `YAMLSubsetError` naming the line.
"""

import pytest

from hank_tpu.model import yaml_subset
from hank_tpu.models import SHIPPED, model_path


@pytest.mark.parametrize("name", sorted(SHIPPED))
def test_shipped_spec_matches_safe_load(name):
    yaml = pytest.importorskip("yaml")
    path = model_path(name)
    with open(path, encoding="utf-8") as f:
        expected = yaml.safe_load(f)
    assert yaml_subset.load_file(path) == expected


SUPPORTED = {
    "int": "a: 7",
    "negative_int": "a: -2",
    "float": "a: 0.966",
    "exponent_float": "a: 1.0e-6",
    "bare_fraction": "a: .5",
    "bools": "a: true\nb: False",
    "nulls": "a: ~\nb: null\nc:",
    "plain_string_with_spaces": "name: Krusell Smith Model",
    "double_quoted_escapes": 'a: "x # not a comment \\u03b2 \\"q\\""',
    "single_quoted": "a: 'it''s'",
    "inline_list": 'a: [-0.03, 0.012, "c", d]',
    "empty_inline_list": "a: []",
    "nested_maps": "a:\n  b:\n    c: [x, y]\n  d: 1",
    "list_of_maps": "a:\n  - name: r\n    value: 1\n  - name: w\n    value: 2.5",
    "indentless_list": "a:\n- 1\n- 2\nb: 3",
    "list_of_scalars": "eqs:\n  - \"B = Bg\"\n  - \"KS = A\"",
    "comments": "# head\na: 1  # trailing\n\n  # indented comment\nb: 2",
    "unicode_keys": "β: 0.98\nρ: 0.966",
}


@pytest.mark.parametrize("text", list(SUPPORTED.values()),
                         ids=list(SUPPORTED))
def test_supported_construct_matches_safe_load(text):
    yaml = pytest.importorskip("yaml")
    assert yaml_subset.load(text) == yaml.safe_load(text)


UNSUPPORTED = {
    "anchor": "a: &x 1",
    "alias": "a: *x",
    "tag": "a: !!str 1",
    "literal_block": "a: |\n  x",
    "folded_block": "a: >-\n  x",
    "flow_mapping": "a: {b: 1}",
    "document_marker": "---\na: 1",
    "directive": "%YAML 1.1\na: 1",
    "tab_indent": "a:\n\t- 1",
    "duplicate_key": "a: 1\na: 2",
    "yaml11_bool": "a: yes",
    "exponent_without_point": "a: 1e-8",
    "octal_int": "a: 0755",
    "nested_inline_list": "a: [[1], 2]",
    "unterminated_quote": 'a: "open',
    "multiline_plain": "a: b\n  c",
    "mapping_in_value": "a: b: c",
    "bad_dedent": "a:\n    b: 1\n  c: 2",
}


@pytest.mark.parametrize("text", list(UNSUPPORTED.values()),
                         ids=list(UNSUPPORTED))
def test_unsupported_syntax_is_refused(text):
    with pytest.raises(yaml_subset.YAMLSubsetError, match=r"^line \d+: "):
        yaml_subset.load(text)
