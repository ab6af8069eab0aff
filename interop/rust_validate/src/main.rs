//! Bit-exact interop validation of the sview_fmindex_tpu corpus against
//! the published `sview-fmindex` crate (the reference implementation).
//!
//! For every case in `corpus.json` this program:
//!   1. re-builds the index from the recorded text + configs through the
//!      reference crate's `FmIndexBuilder` and asserts the produced blob
//!      is BYTE-IDENTICAL to the committed `.blob` fixture, and
//!   2. loads the committed blob through the reference crate's
//!      `FmIndex::load` and asserts `count` / sorted `locate` equal the
//!      recorded expected outputs for every query.
//!
//! Passing both means this package and the reference crate agree on
//! the on-disk format and the query semantics, in both directions.

use std::fs;
use std::path::{Path, PathBuf};

use serde_json::Value;
use sview_fmindex::blocks::{Block2, Block3, Block4, Block5, Block6};
use sview_fmindex::build_config::{LookupTableConfig, SuffixArrayConfig};
use sview_fmindex::text_encoders::{EncodingTable, PassThrough};
use sview_fmindex::{Block, FmIndex, FmIndexBuilder, Position, TextEncoder};

fn b64_decode(s: &str) -> Vec<u8> {
    const A: &[u8; 64] = b"ABCDEFGHIJKLMNOPQRSTUVWXYZabcdefghijklmnopqrstuvwxyz0123456789+/";
    let mut rev = [255u8; 256];
    for (i, &c) in A.iter().enumerate() {
        rev[c as usize] = i as u8;
    }
    let bytes: Vec<u8> = s.bytes().filter(|&b| b != b'=' && b != b'\n').collect();
    let mut out = Vec::with_capacity(bytes.len() * 3 / 4);
    for chunk in bytes.chunks(4) {
        let mut acc: u32 = 0;
        for (i, &b) in chunk.iter().enumerate() {
            assert!(rev[b as usize] != 255, "bad base64 byte {b}");
            acc |= (rev[b as usize] as u32) << (18 - 6 * i);
        }
        let n = chunk.len() * 6 / 8;
        for i in 0..n {
            out.push(((acc >> (16 - 8 * i)) & 0xff) as u8);
        }
    }
    out
}

/// 16-byte-aligned copy (u128 vectors need ALIGN_SIZE 16; `fs::read`'s
/// Vec gives no such guarantee).
struct AlignedBlob {
    buf: Vec<u128>,
    len: usize,
}
impl AlignedBlob {
    fn new(data: &[u8]) -> Self {
        let words = data.len().div_ceil(16);
        let mut buf = vec![0u128; words.max(1)];
        let bytes: &mut [u8] =
            unsafe { std::slice::from_raw_parts_mut(buf.as_mut_ptr() as *mut u8, words * 16) };
        bytes[..data.len()].copy_from_slice(data);
        Self { buf, len: data.len() }
    }
    fn as_slice(&self) -> &[u8] {
        unsafe { std::slice::from_raw_parts(self.buf.as_ptr() as *const u8, self.len) }
    }
    fn as_mut_slice(&mut self) -> &mut [u8] {
        unsafe { std::slice::from_raw_parts_mut(self.buf.as_mut_ptr() as *mut u8, self.len) }
    }
}

fn run_case<P: Position, B: Block, E: TextEncoder>(case: &Value, dir: &Path, encoder: E) {
    let name = case["name"].as_str().unwrap();
    let text = b64_decode(case["text"].as_str().unwrap());
    let symbol_count = case["symbol_count"].as_u64().unwrap() as u32;
    let k = case["kmer_size_config"].as_u64().unwrap() as u32;
    let r = case["sampling_ratio_config"].as_u64().unwrap() as u32;

    let builder = FmIndexBuilder::<P, B, E>::new(text.len(), symbol_count, encoder)
        .unwrap()
        .set_suffix_array_config(if r == 1 {
            SuffixArrayConfig::Uncompressed
        } else {
            SuffixArrayConfig::Compressed(r)
        })
        .unwrap()
        .set_lookup_table_config(if k == 1 {
            LookupTableConfig::None
        } else {
            LookupTableConfig::KmerSize(k)
        })
        .unwrap();

    let golden = fs::read(dir.join(case["blob"].as_str().unwrap())).unwrap();

    // (1) build-side: byte-identical blob
    let mut blob = AlignedBlob::new(&vec![0u8; builder.blob_size()]);
    builder.build(text.clone(), blob.as_mut_slice()).unwrap();
    assert_eq!(
        blob.as_slice(),
        &golden[..],
        "{name}: rebuilt blob differs from the committed fixture"
    );

    // (2) load-side: identical query answers on the committed blob
    let aligned = AlignedBlob::new(&golden);
    let fm = FmIndex::<P, B, E>::load(aligned.as_slice()).unwrap();
    for q in case["queries"].as_array().unwrap() {
        let pat = b64_decode(q["pattern"].as_str().unwrap());
        let want_count = q["count"].as_u64().unwrap();
        let want: Vec<u64> = q["locations"]
            .as_array()
            .unwrap()
            .iter()
            .map(|v| v.as_u64().unwrap())
            .collect();
        assert_eq!(fm.count(&pat).as_u64(), want_count, "{name}: count {pat:?}");
        let mut locs: Vec<u64> = fm.locate(&pat).into_iter().map(|p| p.as_u64()).collect();
        locs.sort();
        assert_eq!(locs, want, "{name}: locate {pat:?}");
    }
    println!("ok  {name}");
}

fn dispatch<P: Position>(case: &Value, dir: &Path) {
    let block = case["block_rust"].as_str().unwrap();
    let table = case["encoder"].as_str().unwrap() == "table";
    macro_rules! go {
        ($b:ty) => {
            if table {
                let symbols: Vec<Vec<u8>> = case["symbols"]
                    .as_array()
                    .unwrap()
                    .iter()
                    .map(|s| b64_decode(s.as_str().unwrap()))
                    .collect();
                let enc = if case["wildcard_reserved"].as_bool().unwrap_or(false) {
                    EncodingTable::from_symbols_with_wildcard(&symbols)
                } else {
                    EncodingTable::from_symbols(&symbols)
                };
                run_case::<P, $b, EncodingTable>(case, dir, enc)
            } else {
                run_case::<P, $b, PassThrough>(case, dir, PassThrough)
            }
        };
    }
    match block {
        "Block2<u32>" => go!(Block2<u32>),
        "Block2<u64>" => go!(Block2<u64>),
        "Block2<u128>" => go!(Block2<u128>),
        "Block3<u32>" => go!(Block3<u32>),
        "Block3<u64>" => go!(Block3<u64>),
        "Block3<u128>" => go!(Block3<u128>),
        "Block4<u32>" => go!(Block4<u32>),
        "Block4<u64>" => go!(Block4<u64>),
        "Block5<u64>" => go!(Block5<u64>),
        "Block6<u64>" => go!(Block6<u64>),
        other => panic!("unknown block type {other}"),
    }
}

fn main() {
    let dir = std::env::args()
        .nth(1)
        .map(PathBuf::from)
        .unwrap_or_else(|| PathBuf::from("../corpus"));
    let manifest: Value =
        serde_json::from_str(&fs::read_to_string(dir.join("corpus.json")).unwrap()).unwrap();
    let cases = manifest["cases"].as_array().unwrap();
    for case in cases {
        match case["position"].as_str().unwrap() {
            "u32" => dispatch::<u32>(case, &dir),
            "u64" => dispatch::<u64>(case, &dir),
            other => panic!("unknown position {other}"),
        }
    }
    println!("all {} cases passed", cases.len());
}
